"""Fisher/CALLHOME Spanish: single-turn and multi-turn preparation, and the long-form resegmentation chain."""

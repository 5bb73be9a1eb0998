"""Training: the step, its optimizer chain and schedules, the trainer."""

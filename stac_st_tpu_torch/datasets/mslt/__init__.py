"""MSLT: the T2 transcripts and T3 translations as joint ASR+ST manifests."""

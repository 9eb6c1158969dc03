"""Training: the single-card CT-CLIP train step, its optimizer, checkpoints and driver."""

"""Zero-shot scoring."""

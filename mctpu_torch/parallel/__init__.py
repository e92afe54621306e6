"""Cross-block reduction (the port runs on one device)."""

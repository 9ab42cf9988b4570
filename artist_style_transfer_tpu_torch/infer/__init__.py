"""Feed-forward stylization."""

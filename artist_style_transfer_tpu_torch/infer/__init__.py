"""Feed-forward stylization and classifier evaluation."""

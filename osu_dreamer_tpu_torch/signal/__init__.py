"""Chart signal widths."""

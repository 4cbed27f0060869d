"""AdamW, out of place."""

"""Model families (dense only so far)."""

"""Device placement of training batches (one card)."""

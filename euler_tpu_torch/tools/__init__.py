"""Host tools of the port (kNN over embeddings)."""

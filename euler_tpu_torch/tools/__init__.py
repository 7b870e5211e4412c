"""Host tools of the port: kNN over embeddings (knn.py) and the JSON →
binary graph data prep (generate_data.py)."""

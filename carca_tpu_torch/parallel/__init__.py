"""Single-device retrieval: catalog embedding and top-k over an index."""

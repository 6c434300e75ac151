"""Model modules: layers, embeddings, encoder, decoders, CARCA."""

"""Models of the port: Wan DiT (with its audio variants), Wan VAE, CLIP vision
tower, umT5 encoder, the dance's pose embedding, the talk's wav2vec2 tower."""

"""Audio frontend and the wav2vec2 encoder."""

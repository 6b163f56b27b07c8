"""Training steps of the port: the stage-1 FaceFormer trainer."""

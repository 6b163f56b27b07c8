"""Models of the generate path: CLIP text tower, brain network, diffusion
prior, EMOTE talking head and FLINT decoder."""

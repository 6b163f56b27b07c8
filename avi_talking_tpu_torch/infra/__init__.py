"""Device resolution, seeded initialisation and weight transfer from JAX."""

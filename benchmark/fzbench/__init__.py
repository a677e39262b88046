"""The benchmark of `frankenz_tpu_torch`: catalog chunks through
`BruteForce.fit_predict`, timed on the card, checked against a plain
reference.  Nothing here imports JAX or the JAX package; only `cell`
imports the port, and `reference` imports nothing of it."""

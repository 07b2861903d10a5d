"""Statistics layer of the port: log-space probabilities, the PairHMM
family and the HMM (own copies of the JAX package's host modules, and the
batched forwards and scans on the card)."""

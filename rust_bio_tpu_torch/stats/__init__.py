"""Statistics layer of the port: log-space probabilities and the PairHMM
family (own copies of the JAX package's host modules, and the batched
forwards on the card)."""

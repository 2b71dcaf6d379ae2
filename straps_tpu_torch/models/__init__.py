"""Regressor network: ResNet encoders (every depth of the JAX package), IEF
head, weight conversion."""

"""Ports of the JAX repository's prototypes (``protos/``) that compute a
function no other part of the port computes."""

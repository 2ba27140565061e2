"""Tensor ops of the port: grid flattening, decode, NMS."""

"""Tensor ops of the port: the float conv blocks and the quantization
tap, grid flattening, decode, NMS."""

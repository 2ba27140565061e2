"""INT8 fixed-point engine of the port and the post-training quantization
toolchain that builds its models."""

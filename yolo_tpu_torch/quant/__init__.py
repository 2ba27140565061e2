"""INT8 fixed-point engine of the port."""

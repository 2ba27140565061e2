"""Model definitions of the port (this slice: the slim layer schedule)."""

"""Host tools of the port (input data writers)."""

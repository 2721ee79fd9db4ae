"""Host-side helpers of the port (``utils.plot``)."""

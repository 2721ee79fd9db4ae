"""Traffic generators, one per kind; a mix file names its kind."""

"""generate_kernel's share of its roofline over the traced segments,
counting the real stream rows only (%)."""
from benchmark.readers import generate_roofline_pct as read  # noqa: F401

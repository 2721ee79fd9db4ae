"""generate_kernel's share of its roofline in the traced batches (%)."""
from benchmark.readers import generate_roofline_pct as read  # noqa: F401

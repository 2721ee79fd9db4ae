"""The readers of the program's own spans (``benchmark/port_trace.py``) on
hand-made reduced traces: each idle share exact, never above the cell's
idle share, and nothing read where there is nothing to read."""
import numpy as np
import pytest

from benchmark import harness, port_trace, readers
from wavenet_vocoder_tpu_torch.utils import profiling


def _trace(window, ops):
    lo, hi = window
    busy = sum(b - a for a, b in port_trace.tracing._union(
        [(max(a, lo), min(b, hi)) for _, a, b in ops if b > lo and a < hi]))
    return {"window": window, "window_s": (hi - lo) / 1e9,
            "busy_s": busy / 1e9, "ops": ops, "spans": []}


def _with_intervals(monkeypatch, items):
    monkeypatch.setattr(profiling, "intervals", lambda: list(items))


def test_idle_share_is_exact(monkeypatch):
    # busy [1000, 1050] (an op from before the window, clipped),
    # [1100, 1400], [1700, 1800]: idle 550 of 1000 ns
    ops = [("generate_kernel", 500, 1050), ("generate_kernel", 1100, 1300),
           ("upsample", 1250, 1400), ("Memcpy DtoH", 1700, 1800)]
    ctx = {"trace": _trace((1000, 2000), ops)}
    _with_intervals(monkeypatch, [
        ("synth.decode", 1350, 1600),      # 200 ns idle in it
        ("synth.decode", 1450, 1500),      # nested in the first: no more
        ("synth.decode", 1900, 2500),      # 100 ns, up to the window's end
        ("synth.fetch", 1050, 1100),       # another span
        ("synth.decode", 100, 900),        # before the window
    ])
    assert readers.idle_pct(ctx) == pytest.approx(55.0)
    assert port_trace.idle_in_span_pct(ctx, "synth.decode") == \
        pytest.approx(30.0, rel=1e-12)
    assert port_trace.idle_in_span_pct(ctx, "synth.fetch") == \
        pytest.approx(5.0, rel=1e-12)
    assert port_trace.idle_in_span_pct(ctx, "stream.decode") == 0.0
    for name in ("idle.synth.decode", "idle.stream.condition",
                 "idle.stream.decode"):
        span = name[len("idle."):]
        _with_intervals(monkeypatch, [(span, 1400, 1700)])
        assert harness.load_reader(name)(ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("seed", range(5))
def test_idle_shares_never_exceed_idle(monkeypatch, seed):
    rs = np.random.RandomState(seed)
    for _ in range(40):
        lo = int(rs.randint(0, 10 ** 6))
        hi = lo + int(rs.randint(1, 10 ** 6))
        a = rs.randint(lo - 1000, hi + 1000, size=(int(rs.randint(1, 30)), 2))
        ops = [("op", int(x), int(x + abs(d) % 50000 + 1)) for x, d in a]
        ctx = {"trace": _trace((lo, hi), ops)}
        idle = readers.idle_pct(ctx)
        if idle is None:
            continue
        b = rs.randint(lo - 1000, hi + 1000, size=(int(rs.randint(1, 30)), 2))
        ivs = [("s", int(min(x, y)), int(max(x, y))) for x, y in b]
        _with_intervals(monkeypatch, ivs + [("all", lo - 5, hi + 5)])
        share = port_trace.idle_in_span_pct(ctx, "s")
        assert 0.0 <= share <= idle
        # a span over the whole window holds all of its idle time
        assert port_trace.idle_in_span_pct(ctx, "all") == \
            pytest.approx(idle, rel=1e-9)


def test_nothing_read_without_a_trace_or_a_store(monkeypatch):
    ctx = {"trace": None}
    assert port_trace.idle_in_span_pct(ctx, "synth.decode") is None
    # no device op in the window (the CPU): no idle share
    assert port_trace.idle_in_span_pct(
        {"trace": _trace((0, 100), [])}, "synth.decode") is None
    # a program without the store (the parent of the store's commit)
    monkeypatch.delattr(profiling, "intervals")
    ctx = {"trace": _trace((0, 100), [("op", 10, 20)])}
    assert port_trace.idle_in_span_pct(ctx, "synth.decode") is None
    assert harness.load_reader("setup.pack_s")(ctx) is None


def test_setup_seconds_read_the_process_totals(monkeypatch):
    monkeypatch.setattr(profiling, "totals", lambda: {
        "generator.pack": (2, 0.75), "kernels.load": (1, 1.5)})
    assert harness.load_reader("setup.pack_s")({}) == 0.75
    assert harness.load_reader("setup.kernel_load_s")({}) == 1.5
    # a span that never ran reads 0.0
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert harness.load_reader("setup.kernel_load_s")({}) == 0.0

"""The readers of the program's spans: the device's idle time inside a
span, on hand-made device and host spans; nothing read where a trace
holds no span of the name or no device event; and a traced run of the
mask cell on the CPU reporting the contour tracing's time a frame."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, program_spans, run
from benchmark.tests.small import small_tree


def _trace(dev, host, extent, n_steps=1):
    return dict(trace=dict(device=dev, host=host, extent=extent,
                           n_steps=n_steps))


@pytest.mark.parametrize("dev, host, extent, want", [
    # device busy 10-20 and 40-50 of 0-60: idle 0-10, 20-40, 50-60;
    # two overlapping spans 5-25 and 15-35 count 5-10 and 20-35 once
    ([("k", 10, 20), ("k", 40, 50)],
     [("fit.loss", 5, 25), ("fit.loss", 15, 35)], (0, 60), 20.0),
    # a gap 20-40 crossing the span's edges at 30 and at 45
    ([("k", 10, 20), ("k", 40, 50)], [("fit.loss", 30, 45)], (0, 60),
     10.0),
    # a span cut at the extent: only 50-60 of 50-90 is in the slice
    ([("k", 0, 50)], [("fit.loss", 45, 90)], (0, 60), 10.0),
    # other names and the device's own busy time count for nothing
    ([("k", 0, 30), ("k", 25, 60)],
     [("fit.loss", 10, 50), ("fit.grad", 0, 60)], (0, 60), 0.0),
])
def test_idle_inside_a_span(dev, host, extent, want):
    assert program_spans.idle_inside_us(dev, host, extent,
                                        "fit.loss") == want
    got = program_spans.idle_ms_per_step(_trace(dev, host, extent, 4),
                                         "fit.loss")
    assert got == pytest.approx(1e-3 * want / 4)


def test_idle_shares_add_up_to_the_idle_time():
    """Spans that tile the slice split its idle time with nothing left
    over, and the idle time is ``device_idle_pct``'s."""
    dev = [("k", 3, 7), ("k", 12, 13), ("k", 18, 30)]
    host = [("fit.loss", 0, 10), ("fit.grad", 10, 20), ("fit.update", 20,
                                                        40)]
    parts = [program_spans.idle_inside_us(dev, host, (0, 40), n)
             for n in ("fit.loss", "fit.grad", "fit.update")]
    assert parts == [6.0, 7.0, 10.0]
    idle = 40 * (1 - harness.union_us(dev) / 40)
    assert sum(parts) == idle


@pytest.mark.parametrize("dev, host", [
    ([("k", 0, 10)], [("aten::mul", 2, 4), ("ProfilerStep#3", 0, 20)]),
    ([], [("fit.loss", 0, 10)]),
])
def test_nothing_read_without_spans_or_device(dev, host):
    """A parent's trace has no program span, a CPU trace no device
    event: both read ``None``, never 0."""
    assert program_spans.idle_inside_us(dev, host, (0, 20),
                                        "fit.loss") is None
    assert program_spans.idle_ms_per_step(_trace(dev, host, (0, 20)),
                                          "fit.loss") is None
    assert program_spans.idle_ms_per_step(dict(trace=None),
                                          "fit.loss") is None


def test_observation_spans_of_a_trace_file(tmp_path):
    path = tmp_path / "observations.json"
    events = [dict(ph="X", cat="user_annotation", name=n, ts=ts, dur=d)
              for n, ts, d in (("observations.contours", 10, 5),
                               ("observations.contours", 30, 7),
                               ("other", 0, 50))]
    path.write_text(json.dumps(dict(traceEvents=events)))
    r = dict(trace=dict(observations=str(path)))
    assert program_spans.observation_spans(r, "observations.contours") \
        == [("observations.contours", 10.0, 15.0),
            ("observations.contours", 30.0, 37.0)]
    assert program_spans.observation_spans(r, "fit.loss") is None


def test_traced_cpu_run_reports_contours(tmp_path, capsys):
    """The small mask cell traced on the CPU: the contour tracing's
    milliseconds a frame are read from the program's spans; the idle
    readers find no device event and report nothing."""
    root = small_tree(str(tmp_path))
    rc = run.main(["--workload", "genebody_mask_b8", "--seed", "2200000011",
                   "--seconds", "0", "--trace", "1"], device="cpu",
                  root=root)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = res["metrics"]
    assert got["obs_contours_ms.fit"]["unit"] == "ms/frame"
    assert 0.0 < got["obs_contours_ms.fit"]["value"]
    assert not {"loss_idle_ms.fit", "grad_idle_ms.fit",
                "update_idle_ms.fit"} & set(got)

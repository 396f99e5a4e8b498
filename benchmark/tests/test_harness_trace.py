"""The device trace's reading on synthetic profiler events: kernels given
to the wrapper range that launched them, the busy union, the idle gaps by
what the host was doing, and the shares read from them."""

import torch

from benchmark import devtrace
from benchmark.harness import Observation
from benchmark.work import counts
from benchmark.work.peaks import least_seconds


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def events():
    return [
        ev("bench.unit", "user_annotation", 0, 1000),
        ev("cd.step[perUser]", "user_annotation", 10, 900),
        ev("bench.kernel:fused_re", "user_annotation", 20, 10),
        ev("cudaLaunchKernel", "cuda_runtime", 22, 3, correlation=7),
        ev("aten::item", "cpu_op", 400, 300),
        ev("bench.kernel:fused_hvp", "user_annotation", 800, 10),
        ev("cudaLaunchKernel", "cuda_runtime", 802, 3, correlation=8),
        ev("cudaLaunchKernel", "cuda_runtime", 850, 3, correlation=9),
        ev("void (anonymous namespace)::entity_rows_kernel<float>()",
           "kernel", 30, 100, tid=7, correlation=7),
        ev("void (anonymous namespace)::narrow_kernel<float>()", "kernel",
           810, 40, tid=7, correlation=8),
        ev("vectorized_elementwise_kernel", "kernel", 840, 20, tid=7,
           correlation=9),
    ]


def test_summarize():
    launches = [("fused_re", counts.fused_re, (2, 8, 4, 4),
                 torch.tensor(10)),
                ("fused_hvp", counts.fused_hvp, (100, 8, 4),
                 torch.tensor(50))]
    evals = [(counts.fused_re, (2, 8, 4, 4), torch.tensor(10), 1),
             (counts.fused_hvp, (100, 8, 4), torch.tensor(50), 3)]
    t = devtrace.summarize(events(), 0.001, 1, launches, evals)
    assert abs(t.kernel_device_s["fused_re"] - 100e-6) < 1e-12
    assert abs(t.kernel_device_s["fused_hvp"] - 40e-6) < 1e-12
    # busy: [30, 130] and [810, 860]
    assert abs(t.busy_s - 150e-6) < 1e-12
    want = least_seconds(*counts.fused_re(10, 2, 8, 4, 4))[0]
    assert t.kernel_least_s["fused_re"] == want
    hvp = counts.fused_hvp(50, 100, 8, 4)
    assert abs(t.eval_least_s - want
               - least_seconds(3 * hvp.ops, 3 * hvp.nbytes)[0]) < 1e-18
    assert t.idle_gaps[0][0] == "cd.step[perUser] | aten::item"
    assert abs(t.idle_gaps[0][1] - 680e-6) < 1e-12
    names = [k for k, _ in t.device_ops]
    assert names[0].startswith("fused_re: ")
    assert any(k.startswith("fused_hvp: ") for k in names)
    assert "vectorized_elementwise_kernel" in names

    obs = Observation()
    obs.trace = t
    share = devtrace.roofline_share(obs, "fused_re")
    assert abs(share - 100 * want / 100e-6) < 1e-9
    assert devtrace.roofline_share(obs, "fused_glm") is None
    assert abs(devtrace.idle_share(obs) - 85.0) < 1e-9
    assert devtrace.mfu(obs) > 0
    assert set(t.breakdown()) == {"device_ops", "idle_gaps"}


def test_no_device_work_reads_nothing():
    t = devtrace.summarize([ev("bench.unit", "user_annotation", 0, 10)],
                           0.5, 1, [], [])
    obs = Observation()
    obs.trace = t
    assert t.busy_s == 0.0
    assert devtrace.idle_share(obs) is None
    assert devtrace.mfu(obs) is None
    assert devtrace.roofline_share(obs, "fused_re") is None

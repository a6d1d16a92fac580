"""The trace reduction on hand-made events."""

from __future__ import annotations

from portbench import tracing


class Ev:
    def __init__(self, kind, name, start, dur):
        self._k, self._n, self._s, self._d = kind, name, start, dur

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._k in ("kernel", "gpu_memcpy", "gpu_user_annotation") else "DeviceType.CPU"

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_busy_is_the_union_and_gaps_are_named_by_the_innermost_host_activity():
    events = [
        Ev("user_annotation", "portbench.detect_images", 0, 1000),
        Ev("cpu_op", "aten::copy_", 100, 300),
        Ev("cuda_runtime", "cudaMemcpyAsync", 110, 20),
        Ev("kernel", "void nms_mask_kernel<false>(float4 const*, int)", 0, 100),
        Ev("kernel", "void nms_scan_kernel(unsigned long const*)", 50, 100),  # overlaps the first
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 350, 50),
        Ev("kernel", "other", 800, 100),
        Ev("gpu_user_annotation", "portbench.detect_images", 0, 1000),  # not device work
    ]
    t = tracing.reduce(events, window_ns=1000)
    assert t.window_s == 1e-6 and t.kernels == 3
    assert abs(t.busy_s - 300e-9) < 1e-15  # [0, 150] + [350, 400] + [800, 900]
    # Gap [150, 350]: midpoint 250 inside aten::copy_ (its runtime call has
    # ended); gap [400, 800]: midpoint 600 inside the span only.
    assert abs(t.idle_by_host["aten::copy_"] - 200e-9) < 1e-15
    assert abs(t.idle_by_host["portbench.detect_images"] - 400e-9) < 1e-15
    assert abs(t.kernel_seconds(("nms_mask_kernel", "nms_scan_kernel")) - 200e-9) < 1e-15
    assert t.kernel_seconds(("nms_mask",)) == 0.0
    b = t.breakdown()
    assert b["device_ops"][0][1] == 100e-9 and len(b["idle_gaps"]) == 2


def test_no_device_activity_reads_zero_busy():
    t = tracing.reduce([Ev("cpu_op", "aten::add", 0, 10)], window_ns=100)
    assert t.busy_s == 0.0 and t.kernels == 0 and t.breakdown() == {"device_ops": [], "idle_gaps": []}

"""PyTorch port, the int8 learning reports on the CPU at a tiny size:
scripts/torch_int8_ap_delta.py (a detector trained by `train.fit`, then
held-out AP for bf16, int8 absmax, int8 with the output-error clip search
and with the AP clip search of `cli map-txt --quantize-search --gt-dir`)
and scripts/torch_int8_verification_delta.py (an embedder trained by
`recognition.train.fit`, then held-out verification accuracy for bf16,
folded bf16, int8 and int8 with the clip search). Each mode is reported in
order with values in [0, 1]. Apart from tests/test_torch_port_learning.py
because the int8 sites run slowly on the CPU (~75 s for the second).
"""

from scripts import torch_int8_ap_delta, torch_int8_verification_delta
from tests._torch_port_steps import one_torch_thread  # noqa: F401
from tests.test_torch_port_learning import small_validation  # noqa: F401


def test_int8_ap_delta_on_the_cpu():
    res = torch_int8_ap_delta.main(["--steps", "4", "--batch", "4", "--size", "64", "--images", "8",
                                    "--val-images", "4", "--src-scale", "0.4", "--model", "mnet_v3_plain",
                                    "--device", "cpu"])
    assert list(res) == ["bf16", "int8_absmax", "int8_err_search", "int8_ap_search"]
    for aps in res.values():
        assert set(aps) == {"easy", "medium", "hard"} and all(0.0 <= v <= 1.0 for v in aps.values())


def test_int8_verification_delta_on_the_cpu(small_validation):
    res = torch_int8_verification_delta.main(["--epochs", "2", "--batch", "8", "--ids", "4", "--per-id", "4",
                                              "--val-pairs", "5", "--device", "cpu"])
    assert list(res) == ["bf16", "bf16_fold", "int8_absmax", "int8_err_search"]
    assert all(0.0 <= v <= 1.0 for v in res.values())

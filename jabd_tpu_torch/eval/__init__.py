"""WIDER FACE validation: the batched sweep (`run_wider`) and the
official protocol (`wider_eval`), numpy and scipy only."""

from jabd_tpu_torch.eval.wider_eval import evaluate_wider, image_eval  # noqa: F401

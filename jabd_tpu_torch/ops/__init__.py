"""Tensor ops of the port: anchors, box codec, resize, image front end,
greedy NMS (plain version in `nms`, CUDA kernel wrapper in `nms_cuda`)."""

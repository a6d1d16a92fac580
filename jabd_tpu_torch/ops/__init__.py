"""Tensor ops of the port: anchors, box codec, resize, image front end,
greedy NMS (plain version in `nms`, CUDA kernel wrapper in `nms_cuda`),
anchor matching (plain version in `matching`, CUDA kernel wrapper in
`matching_cuda`)."""

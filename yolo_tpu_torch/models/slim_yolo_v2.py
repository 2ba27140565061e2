"""SlimYOLOv2 layer schedule (counterpart of
``yolo_tpu/models/slim_yolo_v2.py``; the float model is not ported yet).
"""

STRIDES = (16,)

# (layer_name, c_in, c_out, followed_by_2x2_maxpool) — the 10-layer
# schedule the INT8 engine iterates (pred follows conv7).
CONV_LAYERS = (
    ("conv1", 3, 16, True),
    ("conv2", 16, 32, True),
    ("conv3_1", 32, 64, False),
    ("conv3_2", 64, 64, True),
    ("conv4_1", 64, 128, False),
    ("conv4_2", 128, 128, True),
    ("conv5", 128, 256, False),
    ("conv6", 256, 256, False),
    ("conv7", 256, 256, False),
)

"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives: dense int8 tensor-core ops/s and
HBM bytes/s at the card's full power limit (NVIDIA's H100 SXM data
sheet). A share of a peak on a card missing here is not reported."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "hbm_bytes": 3.35e12},
}

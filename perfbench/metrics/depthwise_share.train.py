"""Share of the traced device busy time of a train run spent in the
depthwise conv kernels that perfbench/kernels/depthwise/ names (MBConv's
depthwise convs, forward and backward)."""

UNIT = "%"
LAYER = ("MBConv (models.efficientnet: depthwise conv, squeeze-excite, "
         "swish)")
MOVES = "train_images_per_s"


def read(rec):
    s = rec.get("summary")
    if rec.get("entry") != "train" or s is None or s.busy_s <= 0:
        return None
    spent = s.time_matching(rec["kernel_family"]("depthwise"))
    return 100.0 * spent / s.busy_s if spent > 0 else None

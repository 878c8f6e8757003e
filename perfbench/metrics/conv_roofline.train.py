"""The traced train work's model FLOPs (the benchmark's count, items times
flops_per_item) at the card's peak in the configuration's precision, over
the device time of the convolution kernels that perfbench/kernels/conv/
names (cuDNN's fprop, dgrad and wgrad, its FFT stages and complex GEMMs,
and the GEMMs and im2col of ops.conv's native_w route).

It reads true only for a net whose counted FLOPs all run in kernels of
that family: ResNet's count is convolutions alone (transposed ones
included). DLA-34's DCN contraction is counted but runs in the DCN
kernels, and b3's depthwise convs run in the depthwise family, so the
metric lists the ResNet cell alone. A train step counts three forwards;
the stem's data gradient, which training never runs (the image takes no
gradient), is counted within them: about 0.4 % too many FLOPs for
ResNet-101 at 512 px."""

UNIT = "%"
LAYER = ("convolutions (models.common: Conv2d through ops.conv, SameConv2d, "
         "ConvTranspose2d; cuDNN and ATen's GEMM)")
MOVES = "train_images_per_s"


def read(rec):
    s = rec.get("summary")
    if (rec.get("entry") != "train" or s is None or not s.device
            or rec.get("peak_flops") is None or not rec.get("items")):
        return None
    spent = s.time_matching(rec["kernel_family"]("conv"))
    if spent <= 0:
        return None
    least = rec["items"] * rec["flops_per_item"] / rec["peak_flops"]
    return 100.0 * least / spent

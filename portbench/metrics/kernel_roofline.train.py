"""The port's hand-written kernels on the training path (#12, #1, #2 with its
fixed-point passes, #4, #6, #9): their operations' least time over their
device time, percent."""

from portbench.readers import kernel_roofline

PATTERNS = ("conv_narrow_tc", "conv_narrow_kernel", "squaring_kernel", "squaring_bwd_kernel",
            "fixed::max_abs_bits", "fixed::convert", "warp_kernel", "warp_channels_kernel",
            "dfgrad_kernel", "box_sum_kernel")


def read(run):
    return kernel_roofline(run, "train", PATTERNS)

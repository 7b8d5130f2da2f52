"""The port's hand-written kernels on the UQ path (#13, #11, #10, #1, #4):
their operations' least time over their device time, percent."""

from portbench.readers import kernel_roofline

PATTERNS = ("conv_unit_tc", "conv_unit_kernel", "vel_head_tc", "vel_head_f32",
            "squaring_kernel", "warp_kernel", "warp_channels_kernel")


def read(run):
    return kernel_roofline(run, "uq", PATTERNS)

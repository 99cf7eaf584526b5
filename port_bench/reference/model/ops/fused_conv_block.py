"""FAN's ConvBlock takes no fused path here: every block runs as the
module's own chain (batch norm → ReLU → conv, three times, cat, + x)."""


def fused_convblock_enabled(p, x) -> bool:
    return False


def args_in_program(p):
    return None


def fused_conv_block(x, args):
    raise NotImplementedError("the reference has no fused ConvBlock")


conv_block_fused = fused_conv_block

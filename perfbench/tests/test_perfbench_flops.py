"""The model FLOPs of the reference UNet by FlopCounterMode against a
hand count of its convolutions."""

import torch

from perfbench.reference.nets import UNet
from perfbench.roofline import flops


def conv(cin, cout, k, hw):
    """2 x MACs of a k x k convolution writing hw x hw pixels."""
    return 2 * cin * cout * k * k * hw * hw


def convt(cin, cout, hw_in):
    """2 x MACs of the 2 x 2 stride-2 transposed convolution."""
    return 2 * cin * cout * 4 * hw_in * hw_in


def hand_count():
    f = conv(2, 4, 3, 16) + conv(4, 4, 3, 16)                 # inc
    f += conv(4, 8, 3, 8) + conv(8, 8, 3, 8)                  # down1
    for hw in (4, 2, 1):                                      # down2..4
        f += conv(8, 8, 3, hw) + conv(8, 8, 3, hw)
    for hw_in in (1, 2, 4):                                   # up1..3
        f += convt(8, 4, hw_in) + conv(12, 8, 3, 2 * hw_in) \
            + conv(8, 8, 3, 2 * hw_in)
    f += convt(8, 4, 8) + conv(8, 4, 3, 16) + conv(4, 4, 3, 16)   # up4
    f += conv(4, 2, 1, 16)                                    # outc
    return f


def test_unet_forward_flops_equal_the_hand_count():
    model = UNet(2, 2, widths=(4, 8, 8, 8, 8))
    got = flops.count(model, torch.empty(1, 2, 16, 16), backward=False)
    assert got == hand_count()


def test_unet_training_flops_add_both_gradients_but_the_inputs():
    # Backward: every convolution's weight gradient and input gradient
    # (each the forward's FLOPs), except the first one's input gradient.
    model = UNet(2, 2, widths=(4, 8, 8, 8, 8))
    got = flops.count(model, torch.empty(1, 2, 16, 16), backward=True)
    assert got == 3 * hand_count() - conv(2, 4, 3, 16)

"""FLOPs of the conv-LSTM surrogates (both KS families) from their shapes:
2 per multiply-add of every convolution (elementwise work, norms and
activations not counted).  A periodic convolution of ``cin`` to ``cout``
channels with kernel ``k`` costs ``2 cin cout k`` per output point; a
stride-2 transposed one ``2 cin cout k`` per input point.  Training counts
a backward pass at twice the forward for every part the loss reaches, and
none for the encodings the rollout detaches."""

from typing import Dict


def conv(cin: int, cout: int, k: int, out: int) -> float:
    return float(2 * cin * cout * k * out)


def residual(cin: int, cout: int, size: int, stride: int):
    out = (size - 1) // stride + 1
    return conv(cin, cout, 1, out) + conv(cin, cout, 3, out) + conv(cout, cout, 3, out), out


def encoder(features, n: int) -> float:
    total, cin, size = 0.0, 1, n
    for cout, stride in zip(features, (2, 2, 1)):
        f, size = residual(cin, cout, size, stride)
        total += f
        cin = cout
    return total


def parts(n: int) -> Dict[str, float]:
    """Forward FLOPs of one frame of each part, on an ``n``-point grid."""
    lat = ((n - 1) // 2 + 1 - 1) // 2 + 1
    return {
        "encoder": encoder((8, 16, 16), n),
        "action_encoder": encoder((2, 4, 4), n),
        "cell": conv(4, 64, 3, lat) + conv(16, 64, 3, lat),
        "decoder": (conv(16, 16, 3, lat) + conv(16, 8, 3, 2 * lat)
                    + conv(8, 1, 7, 4 * lat) + conv(1, 1, 5, 4 * lat)),
    }


def teacher_forced(n: int, frames: int) -> float:
    """A rollout of ``frames`` teacher-forced frames (a world start, or one
    world step from the previous output)."""
    return frames * sum(parts(n).values())


def train_window(n: int, mode: str, length: int, tau: int, tbtt: int) -> float:
    """One TBPTT window of ``length`` frames, forward and backward."""
    p = parts(n)
    reencodes = sum(1 for t in range(length) if t >= tbtt and t % tbtt == 0)
    trained = length * (p["action_encoder"] + p["cell"] + p["decoder"])
    trained += (tau + reencodes) * p["encoder"]
    detached = 0.0
    if mode == "autoreg" and reencodes:
        # Every free-run step encodes its detached output; only the
        # re-encoding steps carry the encoder's gradient.
        detached = (length - tau - reencodes) * p["encoder"]
    return 3 * trained + detached


def val_window(n: int, length: int, tau: int) -> float:
    """One validation window, forward only."""
    p = parts(n)
    return tau * p["encoder"] + length * (p["action_encoder"] + p["cell"] + p["decoder"])

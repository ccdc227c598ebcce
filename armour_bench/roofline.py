"""Published peaks of the card and the work of the collision bank pass,
counted from shapes.

``PEAKS`` is a copy of ``chip_smoke._PEAKS``: keyed by the name that
``torch.cuda.get_device_name()`` gives, with no fallback for a card it
does not list.  The bank pass's bytes and operations are those of the
kernel table of ``PERF.md`` (``chip_smoke.py``'s kernel phase): every
input read once and every output written once, and per (slot, start)
10 operations a hyperplane pair plus 5 per Jacobian column.
"""

from __future__ import annotations

# (name fragment, bytes/s, float32 FLOP/s outside the tensor cores):
# NVIDIA's H100 SXM5 data sheet, dense rates, at the full 700 W
PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),
)
OPS_PER_PIECE = 10  # per (slot, start, pair): 3 mul + 2 add (A.c), 2 sub, 1 neg, 2 compares
OPS_PER_JAC = 5     # per (slot, start, k): 3 mul + 2 add


def peaks(device_name: str) -> dict:
    """The peak row of a card; raises for a card not in ``PEAKS``."""
    for key, bw, fl in PEAKS:
        if key in device_name:
            return {"key": key, "bytes_per_s": bw, "f32_flops": fl}
    raise RuntimeError(f"no peak figures for card {device_name!r}")


def bank_pass_bytes(B, S, P, L, O, T, n, jac: bool, a_bytes: int = 2, o_bytes: int = 4) -> int:
    """Bytes of one launch: the bank A (B,P,3,L,O,T) in ``a_bytes``, the
    offsets dpos/dneg (B,P,L,O,T), the centers c (B,S,3,L,T) and with the
    Jacobian dc (B,S,n,3,L,T) read; g (B,S,L,O,T) and with the Jacobian
    J (B,S,n,L,O,T) written."""
    read = B * P * 3 * L * O * T * a_bytes + 2 * B * P * L * O * T * o_bytes + B * S * 3 * L * T * o_bytes
    written = B * S * L * O * T * o_bytes
    if jac:
        read += B * S * n * 3 * L * T * o_bytes
        written += B * S * n * L * O * T * o_bytes
    return read + written


def bank_pass_ops(B, S, P, L, O, T, n, jac: bool) -> int:
    return B * S * L * O * T * (P * OPS_PER_PIECE + (n * OPS_PER_JAC if jac else 0))


def bank_pass_least_s(peak: dict, B, S, P, L, O, T, n, jac: bool, a_bytes: int = 2,
                      o_bytes: int = 4) -> float:
    """The least time one launch could take: the larger of its bytes over
    the peak bandwidth and its operations over the float32 peak."""
    return max(bank_pass_bytes(B, S, P, L, O, T, n, jac, a_bytes, o_bytes) / peak["bytes_per_s"],
               bank_pass_ops(B, S, P, L, O, T, n, jac) / peak["f32_flops"])

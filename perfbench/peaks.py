"""The yardstick's constants: one NVIDIA H100 SXM at its 700 W limit.

The gather kernels are bound by table lookups: each SM reads 32 shared-
memory words a clock, so 132 SMs at the 1.98 GHz maximum SM clock look
up 8.3635e12 entries a second.  Their integer work runs on the ALU pipe
(64 lanes a clock an SM) or is spread over the ALU and FMA pipes; bytes
move at the HBM3's 3.35 TB/s.  These are fixed numbers, not readings of
the card a run lands on: the card's power limit is printed beside them
in every run, since a card set below 700 W runs slower under load.
"""
SMS = 132
SM_CLOCK_HZ = 1.98e9
LOOKUPS_PER_CLOCK_SM = 32
ALU_LANES_PER_CLOCK_SM = 64
HBM_BYTES_PER_S = 3.35e12

LOOKUPS_PER_S = SMS * LOOKUPS_PER_CLOCK_SM * SM_CLOCK_HZ      # 8.3635e12
ALU_OPS_PER_S = SMS * ALU_LANES_PER_CLOCK_SM * SM_CLOCK_HZ    # 1.6727e13

#: integer ops an 8-bit product costs a gather kernel: its table address
#: (one add) and the accumulate, both on the ALU or the FMA pipe
NARROW_INT_OPS = 2


def gather_floor_s(lookups: float, nbytes: float) -> float:
    """The least time the chip could take for ``lookups`` 8-bit table
    products moving ``nbytes``: the largest of the lookup, integer-op and
    byte floors."""
    return max(lookups / LOOKUPS_PER_S,
               NARROW_INT_OPS * lookups / (2 * ALU_OPS_PER_S),
               nbytes / HBM_BYTES_PER_S)


def describe() -> str:
    return (f"yardstick: {SMS} SMs x {LOOKUPS_PER_CLOCK_SM} lookups a clock "
            f"x {SM_CLOCK_HZ / 1e9:.2f} GHz = {LOOKUPS_PER_S:.4e} lookups/s; "
            f"ALU {ALU_OPS_PER_S:.4e} int ops/s; HBM "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

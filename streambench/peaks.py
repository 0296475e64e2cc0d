"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit)."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12

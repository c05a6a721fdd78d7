"""The published HBM rate of one NVIDIA H100 SXM (NVIDIA's data sheet,
at the full 700 W), frozen for the benchmark's roofline shares."""

HBM_BYTES_S = 3.35e12

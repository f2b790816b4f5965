"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense, at the full 700 W power limit). The card's power limit is read
and printed beside every run, since a card set lower runs slower."""

HBM_BYTES_PER_S = 3.35e12  # HBM3
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # one dense TF32 pass on the tensor cores: the fastest any float32-accurate product can go

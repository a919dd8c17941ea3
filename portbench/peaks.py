"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at the
700 W power limit (NVIDIA's data sheet), and the host link's nominal rate.
A card set below 700 W reaches less; results carry its name and the run's
notes carry its power limit."""

BF16_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12  # HBM3 bytes/s
PCIE_BYTES = 64e9  # PCIe Gen5 x16, nominal bytes/s per direction

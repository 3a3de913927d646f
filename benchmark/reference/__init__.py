"""Plain reference of Anim-NeRF (float32 PyTorch): body model, warp,
field, volume rendering, loss and Adam. Imports nothing of the program."""

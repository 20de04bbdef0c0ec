"""gsavatar_torch: the PyTorch/CUDA port of gsavatar.

A second package beside `gsavatar/`, which stays the reference. This slice
holds the avatar render path: converter -> project -> pairs -> compositor
forward (K1, a hand-written CUDA kernel for Hopper). Entry points run on
the GPU unless the caller passes `device='cpu'`."""

"""The benchmark's plain reference: HNeRV-Boost and NeRV-Boost, their
loss and their optimizer in plain PyTorch, independent of the program
(``models``: the forward passes and the integer stages; ``train``: the
loss, MS-SSIM and Adan).  It imports nothing of the program and nothing
that the program has made."""

"""The benchmark's plain reference: each model family's forward passes in
a file of its own (``<model>.py``, the configuration's ``model`` in lower
case), what they share and the integer stages (``models``), and the
training step's loss, MS-SSIM and Adan (``train``), in plain PyTorch,
independent of the program.  It imports nothing of the program and
nothing that the program has made."""

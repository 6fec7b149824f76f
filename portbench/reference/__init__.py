"""Plain PyTorch computations that decide ``correct``, worked out again
from the inputs the harness made: overlap areas of mesh faces with
raster cells and the mean over them (``overlap``).  Nothing here imports the port, and nothing takes what the port made."""

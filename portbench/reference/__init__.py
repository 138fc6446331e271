"""The plain reference: float32 3D Gaussian splatting in torch alone
(`render.py`). It imports nothing of the program under test."""

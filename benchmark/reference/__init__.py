"""Plain PyTorch references of the benchmark's configurations.

Nothing here imports JAX, the JAX package or the port: each module is written from the
published model (openai/CLIP's `clip/model.py`, torchvision's `models/resnet.py`, PIL's
resampling) and computes in float32 from the weights the benchmark made.
"""

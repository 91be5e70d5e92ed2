"""MAF-YOLO in PyTorch with hand-written Hopper (sm_90a) kernels.

The port of the JAX/Pallas package `mafyolo_tpu`, slice by slice. Public
functions keep the JAX package's NHWC layout; the model runs channels_last
NCHW inside. Nothing here imports jax, flax or mafyolo_tpu.
"""

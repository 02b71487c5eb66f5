"""The port's kernels: one package per TPU kernel family of the JAX
package, each as ``<name>.py`` (the CUDA binding and launch), ``ref.py``
(the plain PyTorch version) and ``ops.py`` (the public wrapper: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel)."""

"""The port's twins of the repo's ``examples/``: each runs as
``python -m repro_torch.examples.<name>`` on the card (``--device cpu``
for the plain PyTorch path) with its example's grid, specs and printed
lines, takes arguments that shrink its steps or requests, and its
``main(argv)`` returns a summary of what it did."""

"""The command-line apps of the port (the JAX package's ``examples/``):
``python -m composablestatespacemodels_torch.examples.<app>`` with
``simulate``, ``filtering``, ``determine_parameters`` or ``interpolate``.
They run on ``--device`` (``cuda`` unless the caller asks for ``cpu``)."""

"""The traffic mixes: ``<name>.json`` parameter files and the scene
writers they use (``scenes``)."""

"""Host-side image transforms (``data.transforms``) and the committed
golden fixtures (the ``.npz`` files beside this module)."""

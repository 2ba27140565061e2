"""Host runtime helpers (``utils.native``: the native preprocessing
library)."""

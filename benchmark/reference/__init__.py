"""The benchmark's plain FLAC codec: a frozen numpy copy of the port's
sequential host codec (``encode.py``, ``decode.py`` and the modules they
use), without the native engine.  It imports nothing of the program."""

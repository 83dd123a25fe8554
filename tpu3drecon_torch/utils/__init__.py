"""Tool helpers: timing (``timing``) and solve checkpoints
(``checkpoint``)."""

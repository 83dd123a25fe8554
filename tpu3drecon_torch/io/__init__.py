"""I/O subsystem: COLMAP sparse-model codecs (numpy and the native C++
reader) and BAL problem files."""

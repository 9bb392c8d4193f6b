"""Native runtime components (C++), bound with ctypes."""

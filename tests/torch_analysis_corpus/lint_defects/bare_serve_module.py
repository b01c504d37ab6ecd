"""Helpers."""
import threading

_LOCK = threading.Lock()


def swap(ref, value):
    with _LOCK:
        old, ref[0] = ref[0], value
    return old

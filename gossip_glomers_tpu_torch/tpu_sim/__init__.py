"""The words-major broadcast simulator on PyTorch, single device."""

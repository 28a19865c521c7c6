"""The model zoo on PyTorch: the dense and MoE families' text path."""

"""Operations and bytes by kernel (``kernels.py``) and by model (one file
per configuration, named as the configuration)."""

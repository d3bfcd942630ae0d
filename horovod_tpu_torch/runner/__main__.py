"""``python -m horovod_tpu_torch.runner`` == the ``hvdrun-torch`` console
script."""

from .launch import main

main()

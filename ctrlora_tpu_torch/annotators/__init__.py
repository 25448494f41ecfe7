"""Condition annotators of the port (counterpart of
``ctrlora_tpu/annotators``): the numpy/cv2 detectors (``simple.py``), their
helpers (``util.py``), the CNN detectors HED, lineart, MLSD, MiDaS,
UniFormer, OpenPose, PiDiNet, bbox, DensePose, ZoeDepth, NormalBAE and
OneFormer (``hed.py``, ``lineart.py``, ``mlsd.py``, ``midas.py``,
``uniformer.py`` with ``ade_palette.py``, ``openpose/``, ``pidinet.py``,
``bbox.py``, ``densepose.py``, ``zoe.py``, ``normalbae.py``,
``oneformer/``, sharing ``nets.py``; weight files found by
``download.py``) and the name registry (``registry.py``), which holds every
name of the JAX registry."""

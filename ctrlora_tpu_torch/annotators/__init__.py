"""Condition annotators of the port (counterpart of
``ctrlora_tpu/annotators``): the numpy/cv2 detectors (``simple.py``), their
helpers (``util.py``), the CNN detectors HED, lineart, MLSD, MiDaS,
UniFormer and OpenPose (``hed.py``, ``lineart.py``, ``mlsd.py``,
``midas.py``, ``uniformer.py`` with ``ade_palette.py``, ``openpose/``,
sharing ``nets.py``; weight files found by ``download.py``) and the name
registry (``registry.py``). The other CNN detectors are registered by name
and raise NotImplementedError until they are ported."""

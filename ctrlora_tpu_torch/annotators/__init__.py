"""Condition annotators of the port (counterpart of
``ctrlora_tpu/annotators``): the numpy/cv2 detectors (``simple.py``), their
helpers (``util.py``), the CNN detectors HED, lineart and MLSD (``hed.py``,
``lineart.py``, ``mlsd.py``, sharing ``nets.py``; weight files found by
``download.py``) and the name registry (``registry.py``). The other CNN
detectors are registered by name and raise NotImplementedError until they
are ported."""

"""Where the CNN detectors' weight files live, and their integrity check
(counterpart of ``ctrlora_tpu/annotators/download.py`` and
``ctrlora_tpu/annotators/hed.py`` ``ckpts_dir``; reference annotator/util.py:8
``annotator_ckpts_path``).

The port never downloads. ``ensure_ckpt`` returns the local path of a
detector's file; where a ``SHA256SUMS`` file in the directory records its
digest, the file is verified against it. A missing file is reported missing
(each detector then logs that it runs on torch's initialisation), and with
``CTRLORA_ALLOW_DOWNLOAD=1`` set ``ensure_ckpt`` raises: place the file by
hand. ``WEIGHT_URLS`` only names where the published files come from, for
that message.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

CKPT_ENV = "CTRLORA_ANNOTATOR_CKPTS"
ALLOW_ENV = "CTRLORA_ALLOW_DOWNLOAD"

# filename -> published source (the JAX package's table)
WEIGHT_URLS = {
    "ControlNetHED.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/ControlNetHED.pth",
    "mlsd_large_512_fp32.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/mlsd_large_512_fp32.pth",
    "sk_model.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/sk_model.pth",
    "sk_model2.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/sk_model2.pth",
    "netG.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/netG.pth",
    "table5_pidinet.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/table5_pidinet.pth",
    "body_pose_model.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/body_pose_model.pth",
    "hand_pose_model.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/hand_pose_model.pth",
    "facenet.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/facenet.pth",
    "upernet_global_small.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/upernet_global_small.pth",
    "scannet.pt": "https://huggingface.co/lllyasviel/Annotators/resolve/main/scannet.pt",
    "ZoeD_M12_N.pt": "https://huggingface.co/lllyasviel/Annotators/resolve/main/ZoeD_M12_N.pt",
    "150_16_swin_l_oneformer_coco_100ep.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/150_16_swin_l_oneformer_coco_100ep.pth",
    "250_16_swin_l_oneformer_ade20k_160k.pth": "https://huggingface.co/lllyasviel/Annotators/resolve/main/250_16_swin_l_oneformer_ade20k_160k.pth",
    "dpt_large_384.pt": "https://storage.googleapis.com/sfr-unicontrol-data-research/annotator/ckpts/dpt_large_384.pt",
    "dpt_hybrid-midas-501f0c75.pt": "https://huggingface.co/lllyasviel/ControlNet/resolve/main/annotator/ckpts/dpt_hybrid-midas-501f0c75.pt",
    "model_final_844d15.pkl": "https://dl.fbaipublicfiles.com/densepose/densepose_rcnn_R_101_FPN_DL_s1x/165712116/model_final_844d15.pkl",
    "yolov4.weights": "https://github.com/AlexeyAB/darknet/releases/download/darknet_yolo_v3_optimal/yolov4.weights",
}


def ckpts_dir() -> str:
    """$CTRLORA_ANNOTATOR_CKPTS, else ``ctrlora_tpu_torch/annotators/ckpts``."""
    return os.environ.get(CKPT_ENV, os.path.join(os.path.dirname(__file__), "ckpts"))


def _read_sums(directory: str) -> dict:
    """{file name: sha256} from ``<directory>/SHA256SUMS`` ('digest name' lines)."""
    sums = {}
    path = os.path.join(directory, "SHA256SUMS")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    sums[parts[1]] = parts[0]
    return sums


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ensure_ckpt(name: str, path: Optional[str] = None) -> str:
    """The local path of detector weight file `name` (``path``, else
    ``ckpts_dir()/name``). An existing file whose digest ``SHA256SUMS``
    records must match it. A missing file's path comes back unchanged, so
    the caller reports it; with CTRLORA_ALLOW_DOWNLOAD=1 a missing file
    raises instead, since the port does not download."""
    directory = os.path.dirname(path) if path else ckpts_dir()
    path = path or os.path.join(directory, name)
    if os.path.exists(path):
        expected = _read_sums(directory).get(name)
        if expected:
            actual = sha256(path)
            if actual != expected:
                raise RuntimeError(f"annotator checkpoint {path} is corrupted: sha256 {actual} "
                                   f"!= recorded {expected}")
        return path
    if os.environ.get(ALLOW_ENV, "") == "1":
        raise RuntimeError(f"{path} is missing and the PyTorch port does not download: "
                           f"{ALLOW_ENV}=1 has no effect here; place {name} (published at "
                           f"{WEIGHT_URLS.get(name, 'no known URL')}) in {directory}")
    return path

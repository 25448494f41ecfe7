"""Vanilla ControlNet gradio UI of the port (counterpart of
app/gradio_controlnet.py): the image-hint ControlNet (cldm_v15 config)
without LoRA, from one combined checkpoint, on the card. Every callback is
one call into ``ctrlora_tpu_torch.apps.logic``.

    python -m ctrlora_tpu_torch.app.gradio_controlnet
"""

import os

try:
    import gradio as gr
except ImportError as e:  # pragma: no cover
    raise SystemExit(
        "gradio is not installed; use the library directly (see README)."
    ) from e

from ctrlora_tpu_torch.apps import logic

CKPT_DIR = "./ckpts/controlnet"

cache = logic.ModelCache()


def ui_process(det, image, prompt, n_prompt, num_samples, ddim_steps, strength,
               scale, seed, ckpt):
    return logic.process_controlnet(
        det, image, prompt, n_prompt, int(num_samples), int(ddim_steps), float(strength),
        float(scale), int(seed), os.path.join(CKPT_DIR, ckpt), cache=cache)


def build_demo():
    with gr.Blocks() as demo:
        gr.Markdown("## Vanilla ControlNet (H100)")
        with gr.Row():
            with gr.Column():
                ckpt = gr.Dropdown(logic.ckpt_choices(CKPT_DIR), label="ControlNet checkpoint")
                det = gr.Dropdown(logic.DET_CHOICES, value="canny", label="Preprocessor")
                image = gr.Image(label="Input image")
            with gr.Column():
                prompt = gr.Textbox(label="Prompt")
                nprompt = gr.Textbox(label="Negative prompt")
                ns = gr.Slider(1, 8, value=1, step=1, label="Samples")
                steps = gr.Slider(1, 100, value=20, step=1, label="DDIM steps")
                strength = gr.Slider(0.0, 2.0, value=1.0, label="Control strength")
                scale = gr.Slider(0.1, 30.0, value=7.5, label="CFG scale")
                seed = gr.Slider(-1, 65535, value=-1, step=1, label="Seed")
                btn = gr.Button("Generate")
                gallery = gr.Gallery(label="Results")
        btn.click(ui_process,
                  [det, image, prompt, nprompt, ns, steps, strength, scale, seed, ckpt],
                  [gallery])
    return demo


if __name__ == "__main__":
    build_demo().launch(server_name="0.0.0.0")

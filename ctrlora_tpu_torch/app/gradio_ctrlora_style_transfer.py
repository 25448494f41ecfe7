"""Style-transfer gradio UI of the port (counterpart of
app/gradio_ctrlora_style_transfer.py): CtrLoRA + IP-Adapter, a condition
image, a style image and a prompt, with the three IP-Adapter target modes
and an optional img2img start, on the card. Every callback is one call
into ``ctrlora_tpu_torch.apps.logic``.

    python -m ctrlora_tpu_torch.app.gradio_ctrlora_style_transfer
"""

import os

try:
    import gradio as gr
except ImportError as e:  # pragma: no cover
    raise SystemExit(
        "gradio is not installed; use ctrlora_tpu_torch.style.StyleCtrLoRA directly."
    ) from e

from ctrlora_tpu_torch.apps import logic

CKPT_SD15_DIR = "./ckpts/sd15"
CKPT_BASECN_DIR = "./ckpts/ctrlora-basecn"
CKPT_LORA_DIR = "./ckpts/ctrlora-loras"
CKPT_IP_DIR = "./ckpts/ip-adapter"

cache = logic.ModelCache()


def ui_process(det, cond_image, style_image, prompt, n_prompt, num_samples,
               ddim_steps, scale, seed, sd_ckpt, cn_ckpt, lora_ckpt, ip_ckpt,
               ip_scale, target, img2img, img2img_strength):
    encoder = os.path.join(CKPT_IP_DIR, "image_encoder.bin")
    return logic.process_style(
        det, cond_image, style_image, prompt, n_prompt, int(num_samples), int(ddim_steps),
        float(scale), int(seed), os.path.join(CKPT_SD15_DIR, sd_ckpt),
        os.path.join(CKPT_BASECN_DIR, cn_ckpt), os.path.join(CKPT_LORA_DIR, lora_ckpt),
        os.path.join(CKPT_IP_DIR, ip_ckpt), float(ip_scale), logic.STYLE_TARGETS[target],
        img2img, float(img2img_strength),
        image_encoder_ckpt=encoder if os.path.exists(encoder) else None, cache=cache)


def build_demo():
    ls = logic.ckpt_choices
    with gr.Blocks() as demo:
        gr.Markdown("## CtrLoRA style transfer (H100)")
        with gr.Row():
            with gr.Column():
                sd = gr.Dropdown(ls(CKPT_SD15_DIR), label="SD checkpoint")
                cn = gr.Dropdown(ls(CKPT_BASECN_DIR), label="Base ControlNet")
                lora = gr.Dropdown(ls(CKPT_LORA_DIR), label="LoRA")
                ip = gr.Dropdown(ls(CKPT_IP_DIR), label="IP-Adapter ckpt")
                target = gr.Dropdown(list(logic.STYLE_TARGETS), value="Load original IP-Adapter",
                                     label="IP target")
                ip_scale = gr.Slider(0.0, 2.0, value=1.0, label="IP scale")
                det = gr.Dropdown(logic.DET_CHOICES, value="canny", label="Preprocessor")
                cond = gr.Image(label="Condition image")
                style = gr.Image(label="Style image")
                img2img = gr.Image(label="img2img start (optional)")
                i2i_strength = gr.Slider(0.0, 1.0, value=0.8, label="img2img strength")
            with gr.Column():
                prompt = gr.Textbox(label="Prompt")
                nprompt = gr.Textbox(label="Negative prompt")
                ns = gr.Slider(1, 8, value=1, step=1, label="Samples")
                steps = gr.Slider(1, 100, value=20, step=1, label="DDIM steps")
                scale = gr.Slider(0.1, 30.0, value=7.5, label="CFG scale")
                seed = gr.Slider(-1, 65535, value=-1, step=1, label="Seed")
                btn = gr.Button("Generate")
                gallery = gr.Gallery(label="Results")
        btn.click(ui_process,
                  [det, cond, style, prompt, nprompt, ns, steps, scale, seed,
                   sd, cn, lora, ip, ip_scale, target, img2img, i2i_strength],
                  [gallery])
    return demo


if __name__ == "__main__":
    build_demo().launch(server_name="0.0.0.0")

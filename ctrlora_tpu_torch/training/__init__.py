"""The finetune step of the PyTorch port: loss, trainable set, optimizer,
step and trainer."""

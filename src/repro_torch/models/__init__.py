# Dense LM building blocks and model assembly (plain PyTorch).

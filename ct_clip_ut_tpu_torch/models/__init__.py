"""CT-ViT, BERT and CTCLIP as nn.Modules named like the reference state dict."""

"""Models of the port: TransformerNet, the VGG16 feature extractor and the ResNet-50
artist classifier."""

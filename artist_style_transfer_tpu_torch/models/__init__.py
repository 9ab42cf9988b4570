"""Models of the port: TransformerNet and the VGG16 feature extractor."""

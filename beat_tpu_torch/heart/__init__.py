"""Forward-model building blocks of the port: GF tables, tapers, datasets."""

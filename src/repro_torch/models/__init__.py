"""Model code: layers, attention, the dense transformer, the Model API."""

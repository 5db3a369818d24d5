"""Data of the port: datasets (synthetic; Volleyball and Collective Activity on disk), the frame
cache and packed store, batching and the copy to the device."""

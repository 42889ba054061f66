"""The paper's table: encoding, hashing, the batched table and its
sequential specification."""

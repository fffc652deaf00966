# Model configurations.  Only VGG-16 / CIFAR-10 is ported so far; the
# transformer configs and ``get_reduced`` come with the model zoo (ROADMAP A14).
